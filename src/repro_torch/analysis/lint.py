"""AST static pass over ``repro.core`` + ``repro.obs`` —
``python -m repro.analysis.lint``.

Checks (source of truth for the hierarchy is the LOCK HIERARCHY table in
``repro/core/locking.py``'s docstring, parsed at startup):

* ``L001`` — every ``threading.Lock``/``RLock``/``Condition`` construction
  in ``repro.core`` must go through the ``locking.make_*`` factories
  (direct constructions are invisible to the runtime checker), and every
  factory call must name a class present in the hierarchy table.
* ``L002`` — no ``time.sleep`` and no backend I/O call (``pwrite``,
  ``pwritev``, ``pread``, ``preadv``, ``fsync``) syntactically inside a
  ``with <shard lock>`` block: the shard alloc lock serializes every
  writer of that shard, so a device round-trip under it is a throughput
  cliff.  Shard-lock attributes are discovered from
  ``make_lock("shard")`` / ``make_condition("shard", ...)`` assignments.
* ``L003`` — every ``<obj>.psync()`` call must be dominated by a
  ``<obj>.pwb(...)`` (or ``store_flush``) on the same object earlier in
  the enclosing function: a psync with nothing flushed persists nothing,
  which almost always means the pwb is missing, not the psync redundant.
  (Dominance is approximated by source order within the function —
  sufficient for the straight-line persist protocols this codebase uses.)
* ``L004`` — a field declared in a class's ``GUARDED_BY`` table (see the
  GUARDED-BY CONTRACT in ``core/locking.py``) accessed as ``self.<field>``
  outside a ``with self.<its guard>`` block.  ``__init__``/``__new__``,
  ``*_locked``-suffixed methods (the callers-hold-it convention), and
  nested function/lambda bodies are exempt; ``"write:lock"`` specs are
  checked on writes only; ``None``/``"volatile"`` specs are not checked.
  (Syntactic approximation: accesses through aliases or explicit
  acquire/release pairs need an allow comment.)
* ``L005`` — a lock-owning class (one that builds a lock via the
  ``make_*`` factories) rebinds a *public* ``self.<attr>`` outside
  ``__init__`` with no ``GUARDED_BY`` declaration for it: mutable shared
  state the race detector cannot see.  Annotation completeness — the
  guarded-by table's version of the hierarchy-table L001 rule.
* ``L006`` — every metric/span name literal (arguments to the
  ``repro.obs.metrics`` constructors / ``Registry`` binders, keys of a
  ``bind_group`` dict, keys of a ``_LEVELS`` span table) must match the
  documented ``subsystem.noun_unit`` grammar (see
  ``src/repro/obs/README.md``); the registry enforces the same rule at
  runtime, this catches names on paths tests never execute.

Suppress a finding by appending ``# lint: allow(CODE)`` to the flagged
line.  Exit status: 0 when clean, 1 with findings (one per line:
``path:line: CODE message``).
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Dict, List, Set, Tuple

from repro_torch.core.locking import parse_hierarchy
from repro_torch.obs.metrics import NAME_RE as _METRIC_NAME_RE

_FACTORIES = {"make_lock", "make_rlock", "make_condition"}
_PRIMITIVES = {"Lock", "RLock", "Condition"}
_IO_CALLS = {"pwrite", "pwritev", "pread", "preadv", "fsync"}
#: call names whose first string-literal argument is a metric/span name
_METRIC_CTORS = {"Counter", "Gauge", "Histogram", "BoundGauge",
                 "counter", "gauge", "histogram", "bind", "bind_summary",
                 "merged_snapshot"}


class Finding:
    def __init__(self, path: Path, line: int, code: str, msg: str):
        self.path, self.line, self.code, self.msg = path, line, code, msg

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.msg}"


def _factory_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _is_threading_primitive(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr in _PRIMITIVES
            and isinstance(f.value, ast.Name) and f.value.id == "threading")


def _literal_class_arg(call: ast.Call):
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def collect_shard_attrs(trees: Dict[Path, ast.Module]) -> Set[str]:
    """Attribute names assigned from ``make_lock("shard")`` /
    ``make_condition("shard", ...)`` — the ``with`` targets L002 guards."""
    attrs: Set[str] = set()
    for tree in trees.values():
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or \
                    not isinstance(node.value, ast.Call):
                continue
            call = node.value
            if _factory_name(call) not in _FACTORIES:
                continue
            if _literal_class_arg(call) != "shard":
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute):
                    attrs.add(tgt.attr)
    return attrs


def _suppressed(src_lines: List[str], line: int, code: str) -> bool:
    if 0 < line <= len(src_lines):
        return f"lint: allow({code})" in src_lines[line - 1]
    return False


# ------------------------------------------------------- guarded-by helpers

def _self_attr(node) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "self")


def _eval_spec(v):
    """Best-effort static value of one GUARDED_BY entry."""
    if isinstance(v, ast.Constant):
        return v.value                    # str or None
    if isinstance(v, ast.Tuple):
        return tuple(e.value for e in v.elts
                     if isinstance(e, ast.Constant))
    if isinstance(v, ast.Attribute) and v.attr == "VOLATILE":
        return "volatile"
    if isinstance(v, ast.Name) and v.id == "VOLATILE":
        return "volatile"
    return None                           # unknown: treat as HB-only


def _guarded_table(cls_node: ast.ClassDef):
    """The class's ``GUARDED_BY`` dict, statically evaluated; None when
    the class declares none."""
    for stmt in cls_node.body:
        if not isinstance(stmt, ast.Assign):
            continue
        for tgt in stmt.targets:
            if isinstance(tgt, ast.Name) and tgt.id == "GUARDED_BY" \
                    and isinstance(stmt.value, ast.Dict):
                out = {}
                for k, v in zip(stmt.value.keys, stmt.value.values):
                    if isinstance(k, ast.Constant) and \
                            isinstance(k.value, str):
                        out[k.value] = _eval_spec(v)
                return out
    return None


def _owns_lock(cls_node: ast.ClassDef) -> bool:
    for node in ast.walk(cls_node):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _factory_name(node.value) in _FACTORIES \
                and any(_self_attr(t) for t in node.targets):
            return True
    return False


def _required_guards(spec, is_write: bool):
    """The set of ``self.<attr>`` guard names satisfying the spec for this
    access, or None when the access is unchecked."""
    if spec is None or spec == "volatile":
        return None
    if isinstance(spec, str):
        if spec.startswith("write:"):
            return {spec[len("write:"):]} if is_write else None
        return {spec}
    if isinstance(spec, tuple):
        return set(spec)
    return None


def lint_file(path: Path, tree: ast.Module, hierarchy: Dict[str, dict],
              shard_attrs: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    src_lines = path.read_text().splitlines()

    def flag(node: ast.AST, code: str, msg: str) -> None:
        if not _suppressed(src_lines, node.lineno, code):
            findings.append(Finding(path, node.lineno, code, msg))

    is_locking_mod = path.name == "locking.py"

    # ---- L001: constructions + factory names ----------------------------
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "threading":
            for alias in node.names:
                if alias.name in _PRIMITIVES:
                    flag(node, "L001",
                         f"import of threading.{alias.name}: construct "
                         f"locks via repro.core.locking.make_*")
        if not isinstance(node, ast.Call):
            continue
        if _is_threading_primitive(node) and not is_locking_mod:
            flag(node, "L001",
                 f"direct threading.{node.func.attr}() in core/ — use "
                 f"repro.core.locking.make_* so the hierarchy checker "
                 f"sees it")
        if _factory_name(node) in _FACTORIES and not is_locking_mod:
            name = _literal_class_arg(node)
            if name is None:
                flag(node, "L001",
                     "lock class name must be a string literal (the "
                     "hierarchy table is static)")
            elif name not in hierarchy:
                flag(node, "L001",
                     f"lock class {name!r} not in the hierarchy table "
                     f"(core/locking.py docstring)")

    # ---- L002: sleep / backend I/O under a shard lock -------------------
    if shard_attrs:
        for node in ast.walk(tree):
            if not isinstance(node, ast.With):
                continue
            if not any(isinstance(it.context_expr, ast.Attribute)
                       and it.context_expr.attr in shard_attrs
                       for it in node.items):
                continue
            for sub in ast.walk(node):
                if sub is node or not isinstance(sub, ast.Call):
                    continue
                fn = sub.func
                name = fn.attr if isinstance(fn, ast.Attribute) else (
                    fn.id if isinstance(fn, ast.Name) else "")
                if name == "sleep" or name in _IO_CALLS:
                    flag(sub, "L002",
                         f"{name}() syntactically inside a `with <shard "
                         f"lock>` block — every writer of the shard "
                         f"serializes behind it")

    # ---- L003: psync dominated by pwb on the same object ----------------
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        calls: List[Tuple[int, str, str]] = []   # (line, obj, method)
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call) and \
                    isinstance(sub.func, ast.Attribute) and \
                    sub.func.attr in ("psync", "pwb", "store_flush"):
                calls.append((sub.lineno, ast.unparse(sub.func.value),
                              sub.func.attr))
        for line, obj, meth in calls:
            if meth != "psync":
                continue
            if obj == "self" and fn.name in ("psync", "pfence"):
                continue                  # the primitive's own definition
            if not any(l < line and o == obj and m in ("pwb", "store_flush")
                       for l, o, m in calls):
                flag_node = ast.Expr(lineno=line)  # carries the lineno only
                flag(flag_node, "L003",
                     f"{obj}.psync() not dominated by a {obj}.pwb() in "
                     f"{fn.name}() — nothing was flush-requested here")

    # ---- L006: metric/span name grammar ---------------------------------
    def _check_metric_name(node: ast.AST, name: str) -> None:
        if not _METRIC_NAME_RE.match(name):
            flag(node, "L006",
                 f"metric/span name {name!r} violates the documented "
                 f"subsystem.noun_unit grammar (src/repro/obs/README.md)")

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fname = _factory_name(node)
            if fname in _METRIC_CTORS:
                lit = _literal_class_arg(node)
                if lit is not None:
                    _check_metric_name(node, lit)
            elif fname == "bind_group" and node.args and \
                    isinstance(node.args[0], ast.Dict):
                for k in node.args[0].keys:
                    if isinstance(k, ast.Constant) and \
                            isinstance(k.value, str):
                        _check_metric_name(k, k.value)
        elif isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Dict) and \
                any(isinstance(t, ast.Name) and t.id == "_LEVELS"
                    for t in node.targets):
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    _check_metric_name(k, k.value)

    # ---- L004/L005: the guarded-by contract -----------------------------
    for cls_node in ast.walk(tree):
        if not isinstance(cls_node, ast.ClassDef):
            continue
        table = _guarded_table(cls_node)
        if table:
            _check_l004(cls_node, table, flag)
        if _owns_lock(cls_node):
            _check_l005(cls_node, table or {}, flag)

    return findings


def _check_l004(cls_node: ast.ClassDef, table: dict, flag) -> None:
    """Guarded ``self.<field>`` accesses must sit inside a
    ``with self.<guard>`` block."""

    def with_guards(node: ast.With):
        names = set()
        for it in node.items:
            if _self_attr(it.context_expr):
                names.add(it.context_expr.attr)
        return names

    def visit(node, held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return                        # nested defs run elsewhere
        if isinstance(node, ast.With):
            held = held | with_guards(node)
        elif _self_attr(node) and node.attr in table:
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            req = _required_guards(table[node.attr], is_write)
            if req is not None and not (req & held):
                want = "|".join(sorted(req))
                flag(node, "L004",
                     f"{cls_node.name}.{node.attr} "
                     f"{'written' if is_write else 'read'} outside "
                     f"`with self.{want}` (its GUARDED_BY declaration)")
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for meth in cls_node.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if meth.name in ("__init__", "__new__") or \
                meth.name.endswith("_locked"):
            continue
        for stmt in meth.body:
            visit(stmt, set())


def _check_l005(cls_node: ast.ClassDef, table: dict, flag) -> None:
    """Public attrs rebound outside __init__ need a GUARDED_BY entry."""
    seen: Set[str] = set()
    for meth in cls_node.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if meth.name in ("__init__", "__new__"):
            continue
        for node in ast.walk(meth):
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign,)):
                targets = [node.target]
            else:
                continue
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Call) and \
                    _factory_name(node.value) in _FACTORIES:
                continue                  # the lock itself
            for tgt in targets:
                if not _self_attr(tgt):
                    continue
                attr = tgt.attr
                if attr.startswith("_") or attr in table or attr in seen:
                    continue
                seen.add(attr)
                flag(tgt, "L005",
                     f"public mutable attribute {cls_node.name}.{attr} "
                     f"assigned outside __init__ with no GUARDED_BY "
                     f"declaration — the race detector cannot check it")


def run(paths: List[Path]) -> List[Finding]:
    hierarchy = parse_hierarchy()
    files: List[Path] = []
    for p in paths:
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    trees = {f: ast.parse(f.read_text()) for f in files}
    shard_attrs = collect_shard_attrs(trees)
    findings: List[Finding] = []
    for f, tree in trees.items():
        findings.extend(lint_file(f, tree, hierarchy, shard_attrs))
    return findings


def main(argv: List[str]) -> int:
    import repro_torch.core as core
    import repro_torch.obs as obs
    defaults = [Path(core.__file__).parent, Path(obs.__file__).parent]
    paths = [Path(a) for a in argv] or defaults
    findings = run(paths)
    for f in findings:
        print(f)
    if findings:
        print(f"lint: {len(findings)} finding(s)")
        return 1
    nfiles = sum(len(list(p.rglob('*.py'))) if p.is_dir() else 1
                 for p in paths)
    print(f"lint: OK ({nfiles} files, hierarchy classes: "
          f"{len(parse_hierarchy())})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
